# Single-process attention strategies of the torch port (the M == 1 branches).
