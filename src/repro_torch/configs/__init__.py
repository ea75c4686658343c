# Model and shape configs (a copy of the reference's, pure data).
