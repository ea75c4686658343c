# Model layer of the torch port: specs, layers, attention, the decoder and the encoder-decoder.
