# Model layer of the torch port: specs, layers, attention and the decoder.
