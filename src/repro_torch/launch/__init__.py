# Launch helpers of the torch port: meshes, the serving and training CLIs.
