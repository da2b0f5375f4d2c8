"""The kernel library's build (ppoc_tpu_torch/ops/_build.py) without a
CUDA toolkit: a stand-in nvcc on CUDA_HOME records its calls, so the
tests check what the build asks of nvcc -- one compile per csrc/*.cu,
all started before any is waited on, then one link -- and that a failing
compile raises with the compiler's output and leaves no library.
"""
import os
import stat

import pytest

from ppoc_tpu_torch.ops import _build

FAKE_NVCC = """#!/bin/sh
out=""; prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  prev="$a"
done
echo "$(date +%s%N) $*" >> "{log}"
case "$*" in *{fail}*) echo "error: cannot compile" ; exit 2 ;; esac
sleep 1
echo "ptxas info    : Used 32 registers"
echo built > "$out"
"""


@pytest.fixture
def fake_toolkit(tmp_path, monkeypatch):
    def make(fail="no-such-source"):
        home = tmp_path / "cuda"
        (home / "bin").mkdir(parents=True, exist_ok=True)
        nvcc = home / "bin" / "nvcc"
        nvcc.write_text(FAKE_NVCC.format(log=tmp_path / "calls.log",
                                         fail=fail))
        nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
        monkeypatch.setenv("CUDA_HOME", str(home))
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
        return tmp_path / "calls.log"
    return make


def test_build_compiles_each_source_in_parallel_then_links(fake_toolkit):
    log = fake_toolkit()
    info = _build.build()
    assert info["built"] and os.path.exists(info["path"])
    calls = [line.split(" ", 1) for line in log.read_text().splitlines()]
    sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    compiles, link = calls[:-1], calls[-1]
    assert sorted(c[1].split(" -c ")[1].split()[0].rsplit("/", 1)[1]
                  for c in compiles) == sources
    assert all("-gencode arch=compute_90a,code=sm_90a" in c[1]
               for c in compiles)
    assert "-shared" in link[1] and link[1].count(".o") == len(sources)
    # every compile started before the first could have finished (1 s)
    starts = [int(c[0]) for c in compiles]
    assert (max(starts) - min(starts)) / 1e9 < 0.8
    assert "Used 32 registers" in (_build.BUILD_DIR / "nvcc.log").read_text()
    assert not _build.build()["built"]          # up to date: no rebuild


def test_build_failure_raises_and_leaves_no_library(fake_toolkit):
    fake_toolkit(fail="update.cu")
    with pytest.raises(RuntimeError,
                       match=r"update\.cu \(exit 2\):\nerror: cannot compile"):
        _build.build()
    assert not (_build.BUILD_DIR / _build.LIB_NAME).exists()
