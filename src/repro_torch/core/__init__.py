"""Diffusion substrate (``diffusion``) and the Ditto engine (``ditto``)."""
