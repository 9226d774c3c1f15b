"""The H100 benchmark of the PyTorch/CUDA port (``cartnet_tpu_torch``).

``run.py`` runs one cell once; README.md says how cells, mixes and
metrics are added. Nothing here imports JAX or the JAX package.
"""
