"""Model programs that plug into the verbs like any user code."""
