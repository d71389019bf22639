"""CPU tests of the benchmark (``python -m pytest benchmark/tests``); the card's are marked ``cuda``."""
