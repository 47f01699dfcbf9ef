"""The plain reference the port is held to: float32 PyTorch, written
from the published models, importing nothing of the program."""
