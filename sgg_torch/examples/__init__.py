"""Walkthroughs of the port (``python -m sgg_torch.examples.<name>``):
scene-graph perturbations, the GAN's feature quality, zero-shot
visualization and training from the feature cache."""
