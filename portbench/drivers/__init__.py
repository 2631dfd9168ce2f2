"""One timed loop a kind of entry: ``setup``, ``window``, ``extras``, ``check``."""
