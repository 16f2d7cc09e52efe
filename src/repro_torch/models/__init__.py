"""Language-model layers and assembly (decoder-only)."""
