"""The LM scaffold's models: dense decoder-only transformers
(``layers``, ``transformer``) and weight conversion from the reference
package (``convert``)."""
