"""Query pipeline on the PyTorch port: encode → ORDER BY → join → GROUP BY
→ top-k, every operator bottoming out in the PlanExecutor.

    PYTHONPATH=src python examples/torch_query_pipeline.py               # on the card
    PYTHONPATH=src python examples/torch_query_pipeline.py --device cpu

The twin of ``examples/query_pipeline.py``: a synthetic orders/customers
pair, each step checked against a numpy oracle.  On a CUDA device the
sorts run the hand-written kernels (``CudaBackend``); on the CPU their
torch-op twin (``TorchBackend``).
"""

import argparse

import numpy as np

from repro_torch.query import (
    IntCodec,
    Table,
    group_by,
    infer_codec,
    order_by,
    sort_merge_join,
    top_k,
)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the tables (default cuda)")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)

    n_customers, n_orders = 256, 1 << 14
    customers = Table({
        "cid": np.arange(n_customers, dtype=np.int32),
        "segment": rng.integers(0, 5, n_customers).astype(np.int32),
        "credit": (rng.standard_normal(n_customers) * 100).astype(np.float32),
    }, device=args.device)
    # zipf-ish customer popularity: the duplicate-heavy join/group-by case
    cid = np.minimum(rng.zipf(1.3, n_orders) - 1, n_customers - 1)
    amount = np.round(rng.gamma(2.0, 30.0, n_orders), 2).astype(np.float32)
    orders = Table({
        "oid": np.arange(n_orders, dtype=np.int32),
        "cid": cid.astype(np.int32),
        "amount": amount,
    }, device=args.device)

    # 1. codecs: exact bit widths size the sort plans
    cid_codec = IntCodec(bits=int(np.ceil(np.log2(n_customers))) + 1)
    amount_codec = infer_codec(orders.column("amount"))
    print(f"codecs: cid -> {cid_codec.bits}-bit code, "
          f"amount -> {amount_codec.bits}-bit code")

    # 2. ORDER BY amount desc, cid asc (composite key, mixed directions)
    ranked = order_by(orders, [("amount", "desc"), ("cid", "asc")],
                      codecs={"cid": cid_codec}).to_numpy()
    want = np.lexsort((cid, -amount))
    assert np.array_equal(ranked["oid"], want.astype(np.int32))
    print(f"order_by: top order {ranked['amount'][0]:.2f} from customer "
          f"{ranked['cid'][0]}")

    # 3. join orders with customers on cid (sort-merge, inner)
    joined = sort_merge_join(orders, customers, "cid",
                             codecs={"cid": cid_codec})
    assert joined.num_rows == n_orders  # every order has a customer
    print(f"join: {orders.num_rows} orders x {customers.num_rows} customers "
          f"-> {joined.num_rows} rows")

    # 4. GROUP BY segment: revenue, order count and largest order
    out = group_by(joined, "segment", {"revenue": ("amount", "sum"),
                                       "orders": (None, "count"),
                                       "biggest": ("amount", "max")}).to_numpy()
    j = joined.to_numpy()
    for i, s in enumerate(out["segment"]):
        m = j["segment"] == s
        np.testing.assert_allclose(out["revenue"][i], j["amount"][m].sum(),
                                   rtol=1e-5)
        assert out["orders"][i] == m.sum()
        assert out["biggest"][i] == j["amount"][m].max()
    print("group_by: revenue per segment = " + ", ".join(
        f"{int(s)}:{r:.0f}" for s, r in zip(out["segment"], out["revenue"])))

    # 5. top-5 orders by amount
    best = top_k(orders, [("amount", "desc")], 5).to_numpy()["amount"]
    assert np.array_equal(best, np.sort(amount)[::-1][:5])
    print("top_k: " + ", ".join(f"{a:.2f}" for a in best))
    print(f"query pipeline OK on {orders.device}")


if __name__ == "__main__":
    main()
