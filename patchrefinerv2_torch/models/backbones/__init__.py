"""Coarse backbones and refiner encoders of the port."""
