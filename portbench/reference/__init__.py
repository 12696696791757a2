"""Plain PyTorch and NumPy references that decide whether a run is correct.

Nothing here imports the program under test.
"""
