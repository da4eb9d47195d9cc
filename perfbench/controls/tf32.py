"""Control: float32 matrix products in TF32.  The configuration states
float32 with TF32 off, and PyTorch's TF32 switches (matmul and cuDNN) are
the program's own path to the precision below it."""

import torch


def apply(port):
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True

    def undo():
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before
    return undo
