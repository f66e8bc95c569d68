"""Decoder, refiner and fusion blocks of the port."""
