"""The benchmark's plain references: float32 PyTorch written from the
architecture and the recipe, importing nothing of the measured program."""
