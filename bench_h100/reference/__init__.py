"""Plain float32 PyTorch references of the benchmark's models, their loss,
Adam with the OneCycle schedules, and the training data order.

Nothing here imports the program under test (``cartnet_tpu_torch``), JAX
or the JAX package: the reference works every derived quantity out again
from the benchmark's records, weights and seed. Module parameters carry
the program's state_dict names, so one weight table loads into both.
"""
