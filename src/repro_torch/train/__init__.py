# Training of the torch port: data, AdamW, the train step, checkpoints, fault handling.
