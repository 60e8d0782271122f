"""Hand-written device kernels (Pallas)."""
