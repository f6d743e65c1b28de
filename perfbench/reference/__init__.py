"""The benchmark's plain reference: a frozen copy of the plain PyTorch
paths of ``pcmi_tpu_torch`` (the matcher's kernels in their plain forms,
geometry, gates, point-cloud ops, fusion and streaming), which imports
nothing of the program. It recomputes what a timed request produced, from
the same raw inputs, so that ``correct`` compares two computations."""
