# Engines of the FlexiNS datapath (torch port): descriptors, the T3
# notification ring and the T4 offload engine.
