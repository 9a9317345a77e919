"""The model stack of the port: parameter descriptors and layer math
(`common`), attention (`attention`) and the layer stack (`lm`).  Dense
attention + MLP layers are ported; the MoE, SSD, cross-attention and
encoder branches raise, naming their ROADMAP item."""
