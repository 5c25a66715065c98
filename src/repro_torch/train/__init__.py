"""Training and serving of the port: step functions, the execution engine and the trainer."""
