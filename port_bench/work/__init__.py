"""Each kernel's work formula, `work/<kernel>.py`: `REFERENCE_OP`, the
reference function (`module:name`) whose calls stand for the kernel's
launches, and `work(*args) -> (bytes, operations, bound_seconds)` from the
same arguments. `CHARGED = True` makes the FLOP count (`flops.py`) charge
the op its operations in place of what its plain formulation computes."""
