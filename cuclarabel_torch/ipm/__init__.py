"""The batched interior-point loop."""
