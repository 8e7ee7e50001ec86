"""The plain reference of the benchmark's configurations: float32 PyTorch with
TF32 off, written from the paper's equations. It imports nothing of the
program under test and takes nothing the program made."""
