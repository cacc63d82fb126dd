"""The drivers, one for each kind of cell (``kind`` in a cell's parameters)."""
