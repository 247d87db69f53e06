"""PyTorch + CUDA port of samtools_tpu (the JAX package stays the reference).

The port keeps the JAX package's module layout so each counterpart is easy
to find, imports ``torch`` and never ``jax`` or ``samtools_tpu``, and runs
its device work on an NVIDIA Hopper card through hand-written CUDA kernels
(``csrc/``).  Entry points take ``device=None``, which means CUDA; the CPU
runs only when the caller asks for it (``device="cpu"``), and there every
kernel wrapper takes its plain PyTorch version.
"""

__version__ = "0.1.0"

# the samtools release whose output the JAX package and the port match
SAMTOOLS_PARITY_VERSION = "1.23.1"
