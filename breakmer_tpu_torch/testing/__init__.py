"""Synthetic planted-SV panels for the port: copies of the repository's test
fixture builder and scenario generator, so that chip_smoke.py and the
panel bench build their panels without the JAX package."""
