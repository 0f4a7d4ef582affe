"""Model assemblies: the paper's four CNNs."""
from . import cnn

__all__ = ["cnn"]
