# Model layer of the torch port (this slice: configs -> cache specs).
