"""Step, boundary, force and diagnostic operators on tensors."""
