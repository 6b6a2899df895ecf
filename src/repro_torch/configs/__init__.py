"""The port's copies of the reference's model configs (`repro.configs`):
the LM configs ported so far with their shapes and smoke reduction,
xDeepFM, and the registry's LM and recsys parts."""
