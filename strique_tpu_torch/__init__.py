"""PyTorch/CUDA port of STRique-TPU's split counting path.

The counterpart of :mod:`strique_tpu` for an NVIDIA Hopper GPU: the
same flank alignment, segment bounds and Viterbi decode, with the
Pallas TPU kernels rewritten as hand-written CUDA kernels
(``csrc/*.cu``, built by :mod:`strique_tpu_torch._build`).  Every
kernel has a plain PyTorch twin in the same module; a wrapper takes the
twin only for tensors on the CPU.

The package imports ``torch`` and never ``jax``, and nothing of
:mod:`strique_tpu`: it keeps its own copies of the jax-free host
modules it needs (pore model, HMM builders and factorizer, NumPy
signal ops, native host prep, ``AlignParams``), under the same names;
tests/test_torch_copies.py pins each copy to its original.
"""

__version__ = "0.1.0"


def __getattr__(name):
    if name == "RepeatCounter":
        from .detect.counter import RepeatCounter

        return RepeatCounter
    raise AttributeError(name)
