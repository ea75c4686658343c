# Attention strategies and partial-softmax merging, the mesh rules, the int8 reduction.
