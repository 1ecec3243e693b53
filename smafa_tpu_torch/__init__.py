"""smafa_tpu_torch: the PyTorch and CUDA port of smafa_tpu.

Searches databases of pre-aligned, equal-length nucleotide sequences
(SingleM marker windows) on one NVIDIA GPU, or on the CPU. The JAX
package ``smafa_tpu`` beside it is the reference the port is held to:
same CLI, same db formats, byte-identical output. ``makedb`` and
best-hit ``query`` are ported; ROADMAP.md lists what is still to come.

The package imports torch and numpy, and never jax.
"""

__version__ = "0.1.0"

CURRENT_DB_VERSION = 2  # reference lib.rs:18

__all__ = ["CURRENT_DB_VERSION", "__version__"]
