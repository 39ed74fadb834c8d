"""Training stacks: self-play PPO over the kernel-backed collector."""
