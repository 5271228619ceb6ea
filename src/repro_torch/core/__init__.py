"""Core LDA types, counts, request keys and frozen-model inference."""
