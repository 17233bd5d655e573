"""The gqa decoder LM and its building blocks."""
