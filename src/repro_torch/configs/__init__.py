"""The port's copies of the reference's model configs (`repro.configs`):
the LM configs ported so far, the registry's LM part and the smoke
reduction."""
