"""The benchmark's own tests run the program on the CPU at small sizes:
two threads a process keep several test processes from oversubscribing
the host."""

import torch

torch.set_num_threads(2)
