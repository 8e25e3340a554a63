"""The plain reference of the benchmark's cells.

Plain PyTorch and NumPy, float32 with TF32 off unless a control asks for a
lower precision. It imports nothing of the program and nothing of the JAX
package: it recomputes, from the inputs the benchmark made and handed to both
sides, what the program's timed path produced, and judges it.
"""
