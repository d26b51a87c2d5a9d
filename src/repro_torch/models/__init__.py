"""The LM scaffold's models: decoder-only transformers, dense and MoE
(``layers``, ``moe``, ``transformer``), and weight conversion from the
reference package (``convert``)."""
