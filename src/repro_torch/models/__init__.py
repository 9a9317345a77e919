"""The model stack of the port: parameter descriptors and layer math
(`common`), attention (`attention`), the SSD mixer (`ssd`), the MoE MLP
(`moe`) and the layer stack with its cross-attention layers and encoder
(`lm`).  The expert-parallel MoE forms raise, naming their ROADMAP
item."""
