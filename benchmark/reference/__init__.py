"""Plain PyTorch references of the configurations' model families, one module
a reference (named by a configuration's ``reference`` key). They import
nothing of the program and take no weights from it: they draw the seeded
weights themselves (``core/weights.py``) and quantize them again."""
