"""The plain reference of the benchmark's train step, in plain PyTorch.

It imports nothing of the system under test, nor JAX. It takes the inputs
the benchmark hands it (the weights it made from the seed, the wire batches
the loader produced, the seeds of the step's random streams) and works out
again, in float32 with TF32 off, what the train step derives from them.
"""
