# Launch helpers of the torch port: the fabric device grid and the serving CLI.
