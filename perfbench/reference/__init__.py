"""Plain PyTorch references of the benchmark's apps.

They follow GraphMat's programs as the port documents them, take the
edges the benchmark drew, and work out again everything the program
derives from them (degrees, orientation, initial factors).  They import
nothing of the program, of the JAX package or of JAX.  Each takes the
``dtype`` its arithmetic runs in: float64 to judge the program, a lower
precision for the control that a check has to fail.
"""
