"""Compositional augmentation on the host: scene-graph perturbations."""
