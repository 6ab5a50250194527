"""One module per kind of timed call; a mix names its driver."""
