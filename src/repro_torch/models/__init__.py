"""The model stack of the port: parameter descriptors and layer math
(`common`), attention (`attention`), the SSD mixer (`ssd`) and the layer
stack (`lm`).  Dense attention + MLP layers and SSD layers are ported;
the MoE, cross-attention and encoder branches raise, naming their
ROADMAP item."""
