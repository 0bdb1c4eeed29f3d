"""The benchmark's plain fp32 reference of the port: the model, the
agent's host side and the training step. Imports nothing of the port."""
