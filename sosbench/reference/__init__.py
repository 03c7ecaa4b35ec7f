"""The benchmark's plain reference: the SOS column solver in plain PyTorch
and NumPy, with its own phase tables and grid.

It imports nothing of the program under test: it is a frozen copy of the
algorithm (the reference's 3-region first order, the affine-scan sweeps,
the polyfit band, the small-µ window, the µ→0⁺ smoothing walk and the
100 ppm truncation per column), run in float64 to judge the program's
float32 answers, or with its products rounded to TF32 as the control.
"""
