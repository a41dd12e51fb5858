"""dlrover_tpu_torch: the PyTorch and CUDA port of dlrover_tpu for NVIDIA Hopper.

The module layout mirrors the JAX package (``common``, ``ops``, ``models``,
``train``, ``checkpoint``, ``run``) so each counterpart is found by name. The port imports
``torch`` and numpy and nothing of JAX or of ``dlrover_tpu``: where it needs
one of that package's stdlib-only helpers it keeps its own copy.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU, where every kernel is replaced by its plain PyTorch version.
"""
