"""The benchmark's plain reference of ``strique count``.

Plain NumPy and PyTorch, independent of the package under test: it
imports nothing of it and takes nothing it made.  From a read's raw
signal, the pore model and the target's sequences it works out the row
``count`` writes (count, score_prefix, score_suffix, log_p, offset,
ticks, mod): host prep, both flank alignments with their tracebacks,
the segment bounds and gate, the Viterbi decode and the host decode of
the count and the float64 log_p, and, given a 5mC twin of the model,
the mod HMM's decode of the repeat samples into the mod string.

Its arithmetic follows the expression trees of STRique's algorithm as
the package states them (the anti-diagonal Gotoh recurrence with its
running vertical-gap maximum, a max-plus Viterbi over the dense
transition matrix, the float64 path log-probability), so a sound run
agrees with it in every column.
"""
