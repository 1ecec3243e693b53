"""smafa_tpu_torch: the PyTorch and CUDA port of smafa_tpu.

Searches databases of pre-aligned, equal-length nucleotide sequences
(SingleM marker windows) on one NVIDIA GPU, or on the CPU. The JAX
package ``smafa_tpu`` beside it is the reference the port is held to:
same CLI, same db formats, byte-identical output. ``makedb``,
``query`` (best-hit and K-mode), ``cluster`` and ``count`` are ported;
ROADMAP.md lists what is still to come.

The package imports torch and numpy, and never jax. ``cluster`` and
``count`` load their modules on first access (PEP 562), so importing
the package loads neither torch nor a kernel.
"""

__version__ = "0.1.0"

CURRENT_DB_VERSION = 2  # reference lib.rs:18

_LAZY = {"cluster": "smafa_tpu_torch.engine.cluster",
         "count": "smafa_tpu_torch.engine.count"}

__all__ = ["cluster", "count", "CURRENT_DB_VERSION", "__version__"]


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
