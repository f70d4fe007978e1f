"""Plain references of what the validator's card passes compute.

Plain PyTorch and NumPy only: nothing here imports the program
(``tpu_operator_torch``), the JAX package or JAX, and nothing takes a
tensor the program made.  Each function draws the inputs again the way the
program draws them (its fixed seeds and constants) and computes the answers
the program's passes give, at a stated precision: the precision the
configuration states, or the one below it for the control.
"""
