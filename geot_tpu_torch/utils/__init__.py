"""Utilities: coloured PLY output (`vis3d`)."""
