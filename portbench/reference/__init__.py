"""Plain fp32 references, one file a model family."""
