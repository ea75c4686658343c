# Launch helpers of the torch port (the fabric device grid).
