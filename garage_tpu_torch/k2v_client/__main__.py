"""k2v CLI (reference src/k2v-client/bin/k2v-cli.rs).

    python -m garage_tpu_torch.k2v_client --endpoint URL --bucket B \
        --key-id GK.. --secret .. <command> ...

Commands: insert, read, delete, poll-item, poll-range, read-index,
read-range, delete-range.  Credentials may also come from the
AWS_ACCESS_KEY_ID / AWS_SECRET_ACCESS_KEY / K2V_ENDPOINT / K2V_BUCKET
environment variables.
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import json
import os
import sys

from .client import K2VClient, K2VError


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="k2v-cli")
    ap.add_argument("--endpoint", default=os.environ.get("K2V_ENDPOINT"))
    ap.add_argument("--bucket", default=os.environ.get("K2V_BUCKET"))
    ap.add_argument("--key-id", default=os.environ.get("AWS_ACCESS_KEY_ID"))
    ap.add_argument("--secret", default=os.environ.get("AWS_SECRET_ACCESS_KEY"))
    ap.add_argument("--region", default="garage")
    sub = ap.add_subparsers(dest="cmd", required=True)

    ins = sub.add_parser("insert")
    ins.add_argument("partition_key")
    ins.add_argument("sort_key")
    ins.add_argument("value", help="literal value, or @file, or - for stdin")
    ins.add_argument("-c", "--causality")

    rd = sub.add_parser("read")
    rd.add_argument("partition_key")
    rd.add_argument("sort_key")
    rd.add_argument("--json", action="store_true", help="values base64 + token")

    dl = sub.add_parser("delete")
    dl.add_argument("partition_key")
    dl.add_argument("sort_key")
    dl.add_argument("-c", "--causality", required=True)

    pi = sub.add_parser("poll-item")
    pi.add_argument("partition_key")
    pi.add_argument("sort_key")
    pi.add_argument("-c", "--causality", required=True)
    pi.add_argument("-T", "--timeout", type=float, default=60.0)

    pr = sub.add_parser("poll-range")
    pr.add_argument("partition_key")
    pr.add_argument("-S", "--seen-marker")
    pr.add_argument("--prefix")
    pr.add_argument("--start")
    pr.add_argument("--end")
    pr.add_argument("-T", "--timeout", type=float, default=60.0)

    ri = sub.add_parser("read-index")
    ri.add_argument("--prefix", default="")
    ri.add_argument("--limit", type=int, default=1000)

    rr = sub.add_parser("read-range")
    rr.add_argument("partition_key")
    rr.add_argument("--start")
    rr.add_argument("--end")
    rr.add_argument("--limit", type=int, default=1000)

    dr = sub.add_parser("delete-range")
    dr.add_argument("partition_key")
    dr.add_argument("--start")
    dr.add_argument("--end")

    args = ap.parse_args(argv)
    for req in ("endpoint", "bucket", "key_id", "secret"):
        if not getattr(args, req):
            ap.error(f"--{req.replace('_', '-')} required (or env var)")
    return asyncio.run(run(args))


def _read_value(spec: str) -> bytes:
    if spec == "-":
        return sys.stdin.buffer.read()
    if spec.startswith("@"):
        # graft-lint: allow-blocking(one-shot CLI client, loop not shared)
        with open(spec[1:], "rb") as f:
            return f.read()
    return spec.encode()


async def run(args) -> int:
    client = K2VClient(
        args.endpoint, args.bucket, args.key_id, args.secret, region=args.region
    )
    try:
        if args.cmd == "insert":
            await client.insert_item(
                args.partition_key, args.sort_key,
                _read_value(args.value), token=args.causality,
            )
            print("ok")
        elif args.cmd == "read":
            vals, tok = await client.read_item(args.partition_key, args.sort_key)
            if args.json:
                print(json.dumps(
                    {"causality": tok,
                     "values": [base64.b64encode(v).decode() for v in vals]}
                ))
            else:
                print(f"causality: {tok}", file=sys.stderr)
                for v in vals:
                    sys.stdout.buffer.write(v + b"\n")
        elif args.cmd == "delete":
            await client.delete_item(
                args.partition_key, args.sort_key, args.causality
            )
            print("deleted")
        elif args.cmd == "poll-item":
            res = await client.poll_item(
                args.partition_key, args.sort_key, args.causality,
                timeout=args.timeout,
            )
            if res is None:
                print("timeout (not modified)", file=sys.stderr)
                return 1
            vals, tok = res
            print(json.dumps(
                {"causality": tok,
                 "values": [base64.b64encode(v).decode() for v in vals]}
            ))
        elif args.cmd == "poll-range":
            res = await client.poll_range(
                args.partition_key, seen_marker=args.seen_marker,
                start=args.start, end=args.end, prefix=args.prefix,
                timeout=args.timeout,
            )
            if res is None:
                print("timeout (not modified)", file=sys.stderr)
                return 1
            items, marker = res
            print(json.dumps(
                {
                    "seenMarker": marker,
                    "items": {
                        sk: {
                            "causality": it["ct"],
                            "values": [
                                base64.b64encode(v).decode()
                                if v is not None else None
                                for v in it["v"]
                            ],
                        }
                        for sk, it in items.items()
                    },
                }
            ))
        elif args.cmd == "read-index":
            idx = await client.read_index(prefix=args.prefix, limit=args.limit)
            print(json.dumps(idx))
        elif args.cmd == "read-range":
            res = await client.read_batch(
                [{"partitionKey": args.partition_key, "start": args.start,
                  "end": args.end, "limit": args.limit}]
            )
            print(json.dumps(res[0]))
        elif args.cmd == "delete-range":
            res = await client.delete_batch(
                [{"partitionKey": args.partition_key, "start": args.start,
                  "end": args.end}]
            )
            print(json.dumps(res[0]))
        return 0
    except K2VError as e:
        print(f"error {e.status}: {e}", file=sys.stderr)
        return 1
    finally:
        # graft-lint: allow-cancel(one-shot CLI: process exits right after teardown)
        await client.close()


if __name__ == "__main__":
    sys.exit(main())
