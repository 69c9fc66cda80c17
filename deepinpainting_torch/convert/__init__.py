"""Weight bridge from the JAX package's flat .npz exports."""
