# Launch helpers of the torch port: the fabric device grid, the serving and training CLIs.
