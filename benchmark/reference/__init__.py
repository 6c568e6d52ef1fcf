"""Plain references of the cells' answers: numpy and PyTorch only."""
