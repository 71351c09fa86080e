"""The benchmark's plain reference: the correlated field under a Poisson
likelihood, its Fisher metric, conjugate gradients, the MGVI draw and the
KL's Newton step, written in plain PyTorch from the model's equations.

It imports nothing of the program under test (nor of ``jax`` or the JAX
package) and takes nothing the program has made: it reads only the
configuration, the inputs the benchmark makes from the seed, and the
program's outputs, which it judges.  It runs in float64 (the reference),
or in a lower precision (the control, :mod:`.precision`)."""
