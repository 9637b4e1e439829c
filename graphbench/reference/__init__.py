"""The plain reference: the graph's update semantics and its queries, written
from their definitions in NumPy and plain PyTorch.

It imports nothing of the program (``repro_torch``), of JAX or of the JAX
package, and takes nothing the program made: it replays the generated
edges and update batches itself.
"""
