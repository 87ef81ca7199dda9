"""The plain reference that decides ``correct``: plain PyTorch, computed
from the benchmark's own weights and batches, importing nothing of the
port (``recommender_tpu_torch``) and nothing of the JAX package.
``reference/<family>.py`` holds a family's loss and gradients, ``train``
follows the first steps of training with them, ``rounding`` the stochastic
rounding of bf16 writes. ``precision="lower"`` computes the same in the
nearest precision below the configuration's (the control: TF32 products
where the configuration computes f32 products with TF32 off, float8 e4m3
values where it rounds to bf16)."""
