"""Model assemblies: the paper's four CNNs and the decoder LMs (the
attention + dense-FFN slice of the JAX package's architectures)."""
from . import cnn, transformer

__all__ = ["cnn", "transformer"]
