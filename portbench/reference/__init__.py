"""The plain reference: MM-DFN's GDF model, its loss and Adam, in plain
PyTorch; it imports nothing of the program."""
