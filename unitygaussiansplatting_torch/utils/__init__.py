"""Configuration, device selection, synthetic scenes and array conversion."""
