"""The LM scaffold's models: the assembler of every family
(``transformer``: decoder-only, hybrid, recurrent, enc-dec and vlm) and
its sublayers (``layers``: attention and MLPs; ``moe``; ``ssm``: mamba;
``xlstm``: mLSTM and sLSTM), and weight conversion from the reference
package (``convert``)."""
