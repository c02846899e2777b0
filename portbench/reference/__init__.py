"""Plain references: PyTorch and NumPy only, importing nothing of the
program under test (``meshdiffusion_tpu_torch``) and nothing of JAX."""
