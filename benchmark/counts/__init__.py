"""Operation and byte counts of the engine's work, from shapes and inputs
alone: whatever implements the work, they read the same amount of it."""
