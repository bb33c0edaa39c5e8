"""Training of the PyTorch port: learning-rate schedules and the Trainer."""
