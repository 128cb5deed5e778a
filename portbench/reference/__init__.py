"""The benchmark's plain reference of DAD-3DNet, the FLAME decode and one
train step: plain PyTorch in fp32, importing nothing of the program."""
