"""
The benchmark's plain reference: what each cell's timed path has to produce,
in plain PyTorch and NumPy, from the inputs the harness made.

Nothing here imports ``jax``, the JAX package or the package under test. The
formulas are frozen copies of the published model (the log-mel of the
reference's ``melspectrogram`` preprocessing, the trunk-pool embedding, the
two wake-word heads, the trainer's mined loss and Adam, the formant render
and the augmentation chain), written out again so that a later change to the
program is held against them and not against itself.
"""
