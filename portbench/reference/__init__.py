"""Plain PyTorch and NumPy references that decide whether a run is correct.

Nothing here imports the program under test. A training configuration's
model family is one module here, which its ``"reference"`` key names
(``implicitnet.py`` says what a family gives).
"""
