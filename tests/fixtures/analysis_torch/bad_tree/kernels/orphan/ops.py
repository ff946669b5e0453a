"""A kernel family no probe covers: kernel-uncovered."""
