"""Tools of the port outside the CIL protocol (``python -m bdvcil_torch.tools.<tool>``):

  train  the plain single-task (non-CIL) trainer, the counterpart of ``tools/train.py``
"""
