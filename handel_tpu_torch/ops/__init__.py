"""Field, tower, curve and pairing arithmetic on limb tensors, and the scalar oracle."""
