"""PPO algorithm and the training driver."""
