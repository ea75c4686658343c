# Serving layer of the torch port: the paged KV pools and the serving engine.
