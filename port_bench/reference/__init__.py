"""The benchmark's plain reference: GIMM-VFI's inference mathematics in
plain PyTorch, float32 unless a precision is asked for. It imports nothing
of the program under test."""
