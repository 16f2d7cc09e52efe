"""Lattice model, payoffs, PWL algebra and the pricing engines."""
