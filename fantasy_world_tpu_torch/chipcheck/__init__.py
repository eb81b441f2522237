"""The port's card check, in phases: ``registry.PHASES`` names them in the
order ``chip_smoke.py`` runs them, and ``registry.run`` runs any of them
with the phases that give what they need. No module here imports torch,
JAX or the JAX package at module level."""
