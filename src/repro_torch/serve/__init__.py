# Serving layer of the torch port (this slice: the paged KV pool).
