"""Host-side adapters: dm_env and Gym views onto the batched engine."""
