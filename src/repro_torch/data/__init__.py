"""Training data: the reference's synthetic token stream and image
batches, in NumPy."""
