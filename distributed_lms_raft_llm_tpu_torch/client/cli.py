"""Interactive LMS terminal client.

The port's copy of `distributed_lms_raft_llm_tpu/client/cli.py`, its
logic as it is.

Covers every screen of the reference Tkinter GUI (reference:
GUI_RAFT_LLM_SourceCode/lms_gui_final.py — register/login, student menu:
view/download materials, upload assignment, view grades, ask query [llm |
instructor], view instructor responses; instructor menu: post material,
view & grade assignments, respond to queries) as a REPL suited to headless
deployments; `client.gui` offers the Tkinter face where displays exist.

Run: python -m distributed_lms_raft_llm_tpu_torch.client.cli \
        --servers 127.0.0.1:50051,127.0.0.1:50052,...
"""

from __future__ import annotations

import argparse
import getpass
import os
import sys

from ..utils import pdf
from .client import LMSClient, NoLeader


def _print_menu(role: str) -> None:
    if role == "student":
        print(
            "\n[student] 1) view course materials  2) download material\n"
            "          3) upload assignment       4) view my grade\n"
            "          5) ask LLM tutor           6) ask instructor\n"
            "          7) view instructor responses  q) logout"
        )
    else:
        print(
            "\n[instructor] 1) post course material  2) view student assignments\n"
            "             3) grade a student        4) view unanswered queries\n"
            "             5) respond to a query     q) logout"
        )


def _read_file(prompt: str) -> tuple:
    path = input(prompt).strip()
    if path and os.path.exists(path):
        with open(path, "rb") as f:
            return os.path.basename(path), f.read()
    # No file? Offer to synthesize a PDF from typed text (demo-friendly).
    text = input("File not found. Enter text to wrap as a PDF instead: ")
    name = input("Filename to upload as [notes.pdf]: ").strip() or "notes.pdf"
    return name, pdf.make_pdf(text)


def student_loop(client: LMSClient) -> None:
    while True:
        _print_menu("student")
        choice = input("> ").strip().lower()
        if choice == "1":
            for e in client.course_materials():
                print(f"  {e.filename} (by {e.instructor}, {len(e.file)} bytes)")
        elif choice == "2":
            entries = client.course_materials()
            for i, e in enumerate(entries):
                print(f"  [{i}] {e.filename}")
            idx = input("which #? ").strip()
            if idx.isdigit() and int(idx) < len(entries):
                e = entries[int(idx)]  # the picked one, not entries[0] (D8)
                # basename: never let a server-supplied name escape the cwd
                name = os.path.basename(e.filename) or "material.pdf"
                with open(name, "wb") as f:
                    f.write(e.file)
                print(f"saved ./{name}")
        elif choice == "3":
            name, content = _read_file("path to assignment PDF: ")
            print("uploaded" if client.upload_assignment(name, content) else "failed")
        elif choice == "4":
            print(" ", client.my_grade())
        elif choice == "5":
            resp = client.ask_llm(input("your question: "))
            print(f"  [{'ok' if resp.success else 'error'}] {resp.response}")
        elif choice == "6":
            print("sent" if client.ask_instructor(input("your question: "))
                  else "failed")
        elif choice == "7":
            for e in client.instructor_responses():
                print(" ", e.data.replace("\n", "\n  "))
        elif choice == "q":
            client.logout()
            return


def instructor_loop(client: LMSClient) -> None:
    while True:
        _print_menu("instructor")
        choice = input("> ").strip().lower()
        if choice == "1":
            name, content = _read_file("path to material PDF: ")
            print("posted" if client.upload_course_material(name, content)
                  else "failed")
        elif choice == "2":
            for e in client.student_assignments():
                print(f"  {e.id}: {e.filename} ({len(e.file)} bytes)")
        elif choice == "3":
            resp = client.grade(input("student: ").strip(),
                                input("grade: ").strip())
            print(f"  [{'ok' if resp.success else 'error'}] {resp.message}")
        elif choice == "4":
            for e in client.unanswered_queries():
                print(f"  {e.id}: {e.data}")
        elif choice == "5":
            ok = client.respond_to_query(
                input("student: ").strip(), input("response: ")
            )
            print("responded" if ok else "failed")
        elif choice == "q":
            client.logout()
            return


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "--servers",
        default="127.0.0.1:50051,127.0.0.1:50052,127.0.0.1:50053,"
                "127.0.0.1:50055,127.0.0.1:50056",
        help="comma-separated LMS server addresses",
    )
    parser.add_argument("--config", default=None,
                        help="TOML deployment file; [cluster.nodes] supplies "
                             "the server list")
    args = parser.parse_args(argv)
    servers = args.servers.split(",")
    client_opts = {}
    # Explicit --servers beats the file (same precedence as the servers).
    if args.config:
        from ..config import client_kwargs, load_config

        cfg = load_config(args.config)
        if args.servers == parser.get_default("servers"):
            servers = cfg.client_servers
        client_opts = client_kwargs(cfg)
    client = LMSClient(servers, **client_opts)

    try:
        leader = client.discover_leader()
        print(f"connected; current leader: {leader}")
    except NoLeader as e:
        print(f"error: {e}")
        sys.exit(1)

    while True:
        action = input("\n1) register  2) login  q) quit\n> ").strip().lower()
        if action == "1":
            user = input("username: ").strip()
            pw = getpass.getpass("password: ")
            role = input("role (student/instructor): ").strip()
            resp = client.register(user, pw, role)
            print(resp.message)
        elif action == "2":
            user = input("username: ").strip()
            pw = getpass.getpass("password: ")
            if client.login(user, pw):
                print(f"logged in as {user} ({client.role})")
                if client.role == "student":
                    student_loop(client)
                else:
                    instructor_loop(client)
            else:
                print("login failed")
        elif action == "q":
            client.close()
            return


if __name__ == "__main__":
    main()
