"""The plain PyTorch reference of the training step; imports nothing of the program."""
