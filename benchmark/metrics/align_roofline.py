"""align_roofline: the least time of the DP cells the traced window's
reads needed, as a share of the alignment kernels' device time.

Cells: n x m for each read submitted and each of its two flank
templates, at the read's own length (``harness/roofline.py`` counts
the operations and bytes).  Device time: the kernels of the table
below, from ``torch.profiler``'s trace.  Layer: the alignment
(``ops/align.py``, ``ops/align_cuda.py``, ``csrc/wave_align.cu``,
``col_align.cu``, ``traceback.cu``).
"""
from harness import roofline

LAYER = "alignment"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "reads_per_s"
KERNELS = ("wave_align_kernel", "wave_cluster_kernel", "col_align_kernel",
           "col_cluster_kernel", "traceback_kernel")


def read(ctx):
    cells = sum(map(sum, ctx["probe"].submits)) * ctx["template_samples"]
    t = roofline.layer_kernel_s(ctx["timeline"].kernels(), KERNELS)
    return roofline.share_pct(roofline.align_bound_s(cells), t)
