"""viterbi_roofline: the least time of the (step, state) pairs the
traced window's repeat segments needed, over the HMM's own states, as a
share of the Viterbi kernels' device time.

Pairs: each decoded segment's length times its HMM's states, counted
by the benchmark's wrapper (``harness/roofline.py`` counts the
operations and bytes).  Device time: the kernels of the table below,
from ``torch.profiler``'s trace.  Layer: the Viterbi (``ops/viterbi.py``,
``ops/viterbi_cuda.py``, ``csrc/viterbi_fwd.cu``, ``viterbi_bwd.cu``,
``viterbi_dense.cu``).
"""
from harness import roofline

LAYER = "Viterbi"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "reads_per_s"
KERNELS = ("viterbi_fwd_kernel", "viterbi_fwd_cluster_kernel", "viterbi_bwd_kernel",
           "viterbi_bwd_wide_kernel", "viterbi_dense_resident_kernel",
           "viterbi_dense_cluster_kernel")


def read(ctx):
    pairs = sum(length * states for length, states in ctx["probe"].segments)
    t = roofline.layer_kernel_s(ctx["timeline"].kernels(), KERNELS)
    return roofline.share_pct(roofline.viterbi_bound_s(pairs), t)
