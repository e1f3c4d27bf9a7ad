"""The plain reference: NumPy and Pillow, nothing of the program."""
